from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.mlp import MLP, FourierEmbedding, PeriodEmbedding, RandomWeightFactorization

__all__ = ["Arch", "MLP", "FourierEmbedding", "PeriodEmbedding", "RandomWeightFactorization"]
