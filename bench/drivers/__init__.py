"""The entries a window drives, one file each: ``run(ctx) -> Run``."""
