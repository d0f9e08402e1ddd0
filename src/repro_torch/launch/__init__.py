"""Launchers of the port: serving and training."""
