"""CLIP towers, weight conversion and serving plans."""
