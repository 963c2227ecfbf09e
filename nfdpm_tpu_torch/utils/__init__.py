"""Configuration (YAML roots with dotted overrides, run directories) and
environment helpers (logging, seeding)."""
