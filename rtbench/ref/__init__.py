"""The benchmark's plain reference of a frame.

A frozen copy of the port's scene code and of the plain torch twins of its
kernels (`config`, `core`, `io`, `models`, `ops`, `utils`), in which every
kernel wrapper runs its twin on any device, and `engine.RefEngine`, which
applies a cell's edits and renders its frames with them. It imports
nothing of `zig_vulkan_tpu_torch`, nothing of JAX, and takes nothing the
program made: it reads the same scene file and the same traffic tables and
works out the records, the skip field, the traversal, the shading and the
post-process again. The port's twins are what its kernels are held
against bit for bit on the card; a later change to the port cannot change
this copy.
"""
