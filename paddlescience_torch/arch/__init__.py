from paddlescience_torch.arch.afno import AFNONet, PrecipNet
from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.cuboid_transformer import CuboidTransformer, ExtFormerMoECuboid
from paddlescience_torch.arch.cvit import CVit, CVit1D
from paddlescience_torch.arch.deeponet import DeepONet
from paddlescience_torch.arch.dgmr import DGMR, DGMRDiscriminator, DGMRDiscriminators
from paddlescience_torch.arch.embedding_koopman import CylinderEmbedding, LorenzEmbedding, RosslerEmbedding
from paddlescience_torch.arch.gan import Discriminator, Generator
from paddlescience_torch.arch.fno import FNONet, TFNO1dNet, TFNO2dNet, TFNO3dNet
from paddlescience_torch.arch.geofno import FNO1d, VelocityDiscriminator, VelocityGenerator
from paddlescience_torch.arch.graph_nets import AMGNet, CFDGCN, CrystalGraphConvNet, GraphCastNet, MeshGraphNet, TGCN
from paddlescience_torch.arch.lno import LNO
from paddlescience_torch.arch.misc_nets import USCNN, ChipDeepONets, Epnn, HEDeepONets, Transformer
from paddlescience_torch.arch.model_list import ModelList
from paddlescience_torch.arch.moflow_net import MoFlowNet, MoFlowProp
from paddlescience_torch.arch.nowcasting import NowcastNet
from paddlescience_torch.arch.phycrnet import PhyCRNet
from paddlescience_torch.arch.phylstm import DeepPhyLSTM
from paddlescience_torch.arch.physx_transformer import PhysformerGPT2
from paddlescience_torch.arch.spinn import SPINN
from paddlescience_torch.arch.mlp import (MLP, FourierEmbedding, ModifiedMLP, PeriodEmbedding, PirateNet,
                                          PirateNetBlock, RandomWeightFactorization)
from paddlescience_torch.arch.sfnonet import SFNONet
from paddlescience_torch.arch.unetex import UNetEx
from paddlescience_torch.arch.unonet import UNONet
from paddlescience_torch.arch.vae import AutoEncoder

__all__ = ["Arch", "DeepONet", "ModelList", "SPINN", "MLP", "ModifiedMLP", "PirateNet", "PirateNetBlock",
           "FourierEmbedding", "PeriodEmbedding", "RandomWeightFactorization", "FNONet", "TFNO1dNet", "TFNO2dNet",
           "TFNO3dNet", "LNO", "UNONet", "FNO1d", "VelocityGenerator", "VelocityDiscriminator", "AFNONet", "PrecipNet",
           "SFNONet", "CVit1D", "CVit", "CuboidTransformer", "ExtFormerMoECuboid", "LorenzEmbedding",
           "RosslerEmbedding", "CylinderEmbedding", "PhysformerGPT2", "TGCN", "MeshGraphNet", "AMGNet", "CFDGCN",
           "GraphCastNet", "CrystalGraphConvNet", "UNetEx", "Epnn", "USCNN", "HEDeepONets", "ChipDeepONets",
           "Transformer", "DeepPhyLSTM", "PhyCRNet", "AutoEncoder", "Generator", "Discriminator", "DGMR",
           "DGMRDiscriminator", "DGMRDiscriminators", "NowcastNet", "MoFlowNet", "MoFlowProp"]
