"""Host-side utilities of the port (video input)."""
