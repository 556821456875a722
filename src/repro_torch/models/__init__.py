"""Backbone modules of the port (dense family)."""
