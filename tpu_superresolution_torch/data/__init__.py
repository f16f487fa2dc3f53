"""Image decode of the port."""
