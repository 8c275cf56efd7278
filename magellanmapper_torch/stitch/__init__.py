"""Tile stitching: phase correlation and fusion on the device, the tile
grid and the acquisition-side helpers."""
