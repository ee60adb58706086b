"""Generator network and weight import."""
