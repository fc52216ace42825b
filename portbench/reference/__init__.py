"""The plain float32 reference that decides a cell's ``correct``.

A frozen copy of the port's plain module code (``megaportraits_tpu_torch``
as of the benchmark's first version: the models, layers, blocks, resizes,
warp, losses and the stage-1 step), with its imports rewritten to this
package and every path into the port's kernels, collectives and factories
taken out: the G2d trunk is the eight plain blocks, BatchNorm is one
process's, the optimiser is ``torch.optim.AdamW``. It imports nothing of
the port, of JAX or of the JAX package. ``dtypes.Policy`` computes in
float32 with TF32 off; ``dtypes.FP8_CONTROL`` is the control, fp8 (e4m3)
operands in every convolution and matmul.
"""
