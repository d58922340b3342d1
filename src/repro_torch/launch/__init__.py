"""Launchers: ``serve.py`` boots the serving engine on a reduced config."""
