"""The admin HTTP plane: route table and server."""
