"""The offline MDM-protocol HumanML3D evaluation of the port (counterpart of
the root ``h3d_eval/``, which stays the JAX package's entry):
``python -m afford_motion_torch.h3d_eval.eval_h3d_offline``."""
