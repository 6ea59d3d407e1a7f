"""Device selection, the threefry PRNG, checkpoint I/O and logging."""
