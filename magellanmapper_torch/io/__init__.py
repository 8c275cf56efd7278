"""Command-line entry of the port."""
