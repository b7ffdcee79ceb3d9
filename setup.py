from setuptools import find_packages, setup

setup(
    name="paddlescience_tpu",
    version="0.1.0",
    description="TPU-native scientific-ML framework (PaddleScience-class) on JAX/XLA/Pallas",
    packages=find_packages(include=["paddlescience_tpu*", "paddlescience_torch*"]),
    package_data={"paddlescience_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy", "scipy", "sympy"],
    # the PyTorch/CUDA port needs only torch and numpy (plus nvcc at run time on the GPU)
    extras_require={"torch": ["torch", "numpy"]},
)
