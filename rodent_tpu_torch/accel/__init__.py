from .builder import build_bvh  # noqa: F401
from .layout import WideBvh  # noqa: F401
