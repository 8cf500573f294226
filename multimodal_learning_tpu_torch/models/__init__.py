from .common import apply_act
from .factory import define_model
from .fusion import (Bilinear, BilinearFusion, HFBFusion, LMFusion,
                     PolynomialFusion, TrilinearFusion)
from .import_flax import flax_from_state_dict, state_dict_from_flax
from .maxnet import MaxNet, MaxNetDecoder
from .mmdynamic import MMDynamic
from .pathomic import (PathomicDynamicsModel, PathomicModel, PathomicOutput,
                       make_fusion)
from .resnet import Bottleneck, ResNet, ResNet18, ResNet34, ResNet50
from .resnet_decoder import ResnetDecoder
