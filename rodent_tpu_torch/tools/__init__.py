"""Command-line tools of the port (rodent_tpu/tools counterparts)."""
