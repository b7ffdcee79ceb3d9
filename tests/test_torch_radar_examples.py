"""The port's radar datasets and ``VisualizerRadar`` against
paddlescience_tpu on the CPU: ``DGMRDataset``, ``RadarDataset``,
``MRMSDataset`` and ``MRMSSampledDataset`` equal to JAX's, synthetic and
read from files; and the radar strip of the same frames written byte for
byte as JAX's writer writes it (where matplotlib imports), with the
nowcastnet_radar example's ``_report`` writing its own. The dgmr and
nowcastnet_radar examples' steps are held in
``test_torch_dgmr_example.py`` and ``test_torch_nowcastnet_radar.py``."""

import numpy as np
import pytest

from _earthformer_parity import one_torch_thread  # noqa: F401
from paddlescience_tpu.data.dataset import domain_dataset as jdata
from paddlescience_torch.data import build_dataset
from paddlescience_torch.examples import nowcastnet_radar as tnr

KEYS = dict(input_keys=("x",), label_keys=("y",))
SYNTHETIC = {"DGMRDataset": dict(number=3, input_frames=2, output_frames=3, H=16, W=24),
             "RadarDataset": dict(image_width=24, image_height=16, total_length=6, input_length=2, num_cases=3),
             "MRMSDataset": dict(num_input_timestamps=2, num_label_timestamps=1, stride=2, H=16, W=8, num_days=2,
                                 frames_per_day=7),
             "MRMSSampledDataset": dict(num_input_timestamps=2, num_label_timestamps=2, H=8, W=16, num_samples=3)}


def _same(t, j):
    for part in ("input", "label"):
        a, b = getattr(t, part), getattr(j, part)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_radar_dataset_matches_jax(name):
    kw = {**KEYS, **SYNTHETIC[name]}
    _same(build_dataset({"name": name, **kw}), getattr(jdata, name)(**kw))


def test_radar_datasets_read_files_as_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(0)
    seqs = tmp_path / "seqs"
    seqs.mkdir()
    for i in range(3):
        np.save(seqs / f"s{i}.npy", rng.uniform(0, 1, (5, 8, 8)).astype(np.float32))
    cases = tmp_path / "cases"
    for c in range(2):
        (cases / f"c{c}").mkdir(parents=True)
        for f in range(6):
            np.save(cases / f"c{c}" / f"{f:02d}.npy", rng.uniform(0, 60, (10, 12)))
    days = tmp_path / "days"
    days.mkdir()
    for d in ("20230101", "20230102"):
        with h5py.File(days / f"mrms_{d}.h5", "w") as f:
            f["dataset"] = rng.uniform(0, 1, (5, 8, 8)).astype(np.float32)
    cfgs = {"DGMRDataset": dict(file_path=str(seqs), number=2, input_frames=2, output_frames=3),
            "RadarDataset": dict(dataset_path=str(cases), image_width=8, image_height=6, total_length=5,
                                 input_length=2),
            "MRMSDataset": dict(file_path=str(days), date_period=("20230101", "20230102"), num_input_timestamps=2),
            "MRMSSampledDataset": dict(file_path=str(days), num_input_timestamps=3, num_label_timestamps=2)}
    for name, cfg in cfgs.items():
        _same(build_dataset({"name": name, **KEYS, **cfg}), getattr(jdata, name)(**KEYS, **cfg))


def test_radar_strip_matches_the_jax_writer(tmp_path):
    pytest.importorskip("matplotlib")
    from paddlescience_tpu.visualize import VisualizerRadar as JVis
    from paddlescience_torch.visualize import VisualizerRadar as TVis

    frames = np.random.default_rng(5).uniform(0.0, 1.0, (6, 32, 32, 1)).astype(np.float32)
    for vis, name in ((JVis, "jax"), (TVis, "torch")):
        vis({"input": frames[None]}, {"pred": lambda d: d["pred"]}).save(str(tmp_path / name), {"pred": frames})
    assert (tmp_path / "torch_pred.png").read_bytes() == (tmp_path / "jax_pred.png").read_bytes()
    solver = tnr.build_solver(epochs=1, output_dir=str(tmp_path / "report"), device="cpu")
    assert np.isfinite(tnr._report(solver))
    assert (tmp_path / "report" / "nowcast_pred.png").stat().st_size > 0
