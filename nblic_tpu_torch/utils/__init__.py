"""Host-side utilities of the port: containers and image files."""
