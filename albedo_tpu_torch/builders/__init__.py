"""Job builders (the reference's ``object ... main`` entry points)."""
