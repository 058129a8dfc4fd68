"""The yardstick's arithmetic: an H100's data-sheet peaks and the work of
the model steps and kernels, counted from shapes.  Frozen copies of the
port's ``launch/roofline.py`` and ``kernels/work.py``; nothing here imports
the port."""
