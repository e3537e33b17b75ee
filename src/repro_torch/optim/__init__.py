"""AdamW as plain tensor functions."""
