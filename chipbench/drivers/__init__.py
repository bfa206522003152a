"""Traffic drivers: one a kind of entry, named by a traffic file."""
