from . import png  # noqa: F401
from . import obj  # noqa: F401
from . import formats  # noqa: F401
