"""Graph substrate of the port: layouts, representations, generators."""
