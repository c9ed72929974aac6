from repro_torch.configs.base import SHAPES, ShapeConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_config  # noqa: F401
