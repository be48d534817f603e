"""CMDM denoiser, its SceneMap PointTransformer encoder, text providers and
condition preparation."""
