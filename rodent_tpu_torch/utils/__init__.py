"""Host-side helpers of the port (counterparts of rodent_tpu.utils modules)."""
