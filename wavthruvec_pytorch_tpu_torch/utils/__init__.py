"""Host-side helpers of the training loops: logs and plots."""
