"""Run configuration (YAML + ``key=value`` overrides) and the model zoo."""
