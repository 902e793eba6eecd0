"""The reference's device and source models, one module each, found by
name (`../registry.py` says what a module declares)."""
