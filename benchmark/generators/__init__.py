"""Traffic generators, named by a mix file's `generator` key."""
