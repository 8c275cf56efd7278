"""Visualisation: colormaps, figure support, 2D task plots, and the ROI
preparation and deconvolution of ``plot_3d``."""
