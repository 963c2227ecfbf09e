"""Configuration (YAML roots with dotted overrides, run directories),
environment helpers (logging, seeding), the hung-step watchdog and the
trainers' profiler hook."""
