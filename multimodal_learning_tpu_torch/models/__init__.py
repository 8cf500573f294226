from .common import apply_act
from .factory import define_model
from .fusion import Bilinear, BilinearFusion
from .import_flax import flax_from_state_dict, state_dict_from_flax
from .maxnet import MaxNet
from .pathomic import PathomicModel, PathomicOutput, make_fusion
from .resnet import ResNet, ResNet18
