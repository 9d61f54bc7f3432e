"""Launchers: ``serve`` and ``train`` (the reference's ``cells``, ``dryrun`` and
``mesh`` are ROADMAP.md item 15c)."""
