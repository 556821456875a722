"""Backbone modules of the port (dense, vlm, audio, MoE and hybrid families)."""
