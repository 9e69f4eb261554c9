"""Storage backends of the port: a local-filesystem bucket."""
