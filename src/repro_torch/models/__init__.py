"""Backbone modules of the port (dense, MoE and hybrid families)."""
