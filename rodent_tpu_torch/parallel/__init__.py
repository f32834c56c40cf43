from .mesh import (make_mesh, render_iteration_sharded,  # noqa: F401
                   render_iteration_persistent_sharded,  # noqa: F401
                   traverse_sharded)  # noqa: F401
