"""The plain reference of the training cells: PyTorch in float32 with TF32
off, no kernel of the port, no import of the program or of JAX.

It works out again, from the corpus generator's items and the run's seed,
everything the program derives on its way to a train step: the curve order
of the clouds and their FPS hierarchies (``geometry``), the item order,
the host's draws and the store's assembly of every batch (``data``), the
models (``models``), the timesteps, noise and dropout masks of every step
and AdamW (``train``). ``train.readings`` gives the numbers that
``perfbench/harness/compare.py`` holds the program's against.

``lowp`` turns it into the control: every matrix product takes its operands
rounded to float8 (e4m3 forward, e5m2 for the gradients), each tensor
scaled by its largest entry, the precision below the configurations'
bfloat16.
"""
