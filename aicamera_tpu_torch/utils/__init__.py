"""Host-side utilities of the port: video and image I/O (MJPEG AVI, JPEG,
PNG) and the drawing overlays."""
