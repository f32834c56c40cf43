"""Host-side helpers of the port (copies of rodent_tpu.utils modules)."""
