"""Process utilities."""
