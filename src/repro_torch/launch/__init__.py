"""Launchers: ``serve`` (the training launchers come with the training slice)."""
