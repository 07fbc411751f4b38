"""Models of the serving path."""
