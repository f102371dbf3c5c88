"""Golden outputs the port is held to, stored as JSON beside their generators."""
