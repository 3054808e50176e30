"""Text encoders: T5 v1.1, CLIP, and the FLUX/SD3 wrappers."""
