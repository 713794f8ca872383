from mocodad_tpu_torch.nn.stsgcn import (  # noqa: F401
    ConvTemporalGraphical, FlaxBatchNorm2d, JointMixLayer, STGCNNLayer,
    compose_graph_operator)
from mocodad_tpu_torch.nn.components import (  # noqa: F401
    Decoder, Encoder, sinusoidal_pos_encoding)
from mocodad_tpu_torch.nn.stsae import STSE, STSAE  # noqa: F401
from mocodad_tpu_torch.nn.unet import STSEUnet, STSAEUnet, joint_pyramid  # noqa: F401
