"""The review GUI's controllers and canvases.

Port of ``magellanmapper_tpu/gui``: the session controller
(``visualizer.Visualization``: load an image, pick an ROI, detect its
blobs on the card, confirm them into the database), the editors behind
the ROI, atlas, plane and verifier views, background workers, the 3D
scene (``vis_3d``: shear-warp frames, depth, camera and picking on the
card, with or without a matplotlib canvas over them) and the Tk window.
matplotlib and tkinter are imported only where a figure or a window is
made, so the controllers run where neither is installed.
"""
