"""The plain reference the benchmark holds the program's outputs against.

Plain PyTorch in float32, written from the published model (VANeRF, AAAI
2024, arXiv 2401.00979; the reference code's ``src/model.py``,
``src/networks.py``, ``src/utils.py``) and from the semantics the program
documents, frozen here so that a later change to the program cannot move
it.  It imports nothing of the program: the modules below carry the
reference checkpoint's parameter names, so one ``state_dict`` made by the
benchmark loads into the program and into the reference alike.  There are
no kernels, no caches, no batching of tiles and no culling: every mesh
query is a sweep over every face.  TF32 stays off unless a caller turns it
on (the lower-precision control does).
"""
