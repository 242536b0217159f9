"""CLIP text tower, weight conversion and serving plans."""
