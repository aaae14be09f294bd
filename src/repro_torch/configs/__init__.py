"""Model configurations served by the port (smollm-135m and its variants)."""
