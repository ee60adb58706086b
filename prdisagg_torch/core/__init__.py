"""Model configuration."""
