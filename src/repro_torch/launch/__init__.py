"""Launchers: the overlay serving engine and its demo CLI."""
