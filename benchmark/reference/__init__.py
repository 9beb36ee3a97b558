"""The plain reference of the benchmark's configurations.

Frozen copies of the port's plain PyTorch modules (CuTR, the CLIP image
tower and its crops, the frame packaging, the device-resident keyframe step,
the PST search and its geometry), under the same layout and names, so that
a weight table fills them as it fills the program.  They import nothing of
the program.  The copies keep only the path the benchmark's cells drive
(the port's ``loops`` step engine), and run the plain forms where the port
runs a kernel: attention, the multi-view fitness and the PST search.  ``engine.py`` assembles
the stages; ``models/cutr/layers.py:cast`` carries the control's float8.
"""
