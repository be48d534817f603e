"""Evaluators of the port (counterpart of ``afford_motion_tpu/eval``): the
stage-1 contact evaluators, the scene-protocol half (SMPL-X fit, LBS, SDF
physics, APD) and the HumanML3D pickle writer; ``eval.visualize`` holds the
visualizers of ``sample.py``."""
from .evaluate import (
    ContactEvaluator,
    ContactHumanML3DEvaluator,
    Eval,
    Text2MotionInSceneEvaluator,
    Text2MotionInSceneHumanML3DEvaluator,
    create_evaluator,
)
from .physics import (
    compute_pairwise_distance,
    dist_to_obj,
    physics_over_sequence,
    signed_distance_to_body,
)

__all__ = [
    "Eval",
    "create_evaluator",
    "ContactEvaluator",
    "ContactHumanML3DEvaluator",
    "Text2MotionInSceneEvaluator",
    "Text2MotionInSceneHumanML3DEvaluator",
    "signed_distance_to_body",
    "physics_over_sequence",
    "dist_to_obj",
    "compute_pairwise_distance",
]
