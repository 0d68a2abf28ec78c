"""Host-side text and image input handling for the serving path."""
