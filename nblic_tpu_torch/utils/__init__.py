"""Host-side utilities of the port: containers, image files and synthetic images."""
