"""Runtime helpers of the port."""
