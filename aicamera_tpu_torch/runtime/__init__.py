"""Weight loading and the fused chunk pipeline."""
