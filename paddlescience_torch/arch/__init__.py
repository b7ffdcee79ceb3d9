from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.deeponet import DeepONet
from paddlescience_torch.arch.model_list import ModelList
from paddlescience_torch.arch.spinn import SPINN
from paddlescience_torch.arch.mlp import (MLP, FourierEmbedding, ModifiedMLP, PeriodEmbedding, PirateNet,
                                          PirateNetBlock, RandomWeightFactorization)

__all__ = ["Arch", "DeepONet", "ModelList", "SPINN", "MLP", "ModifiedMLP", "PirateNet", "PirateNetBlock", "FourierEmbedding",
           "PeriodEmbedding", "RandomWeightFactorization"]
