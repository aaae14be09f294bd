"""Model and training configurations of the port (smollm-135m and its
variants)."""
