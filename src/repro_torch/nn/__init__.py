"""Neural-network substrate of the backend language models."""
