"""Models of the port: GPT's serving half and the weight bridge."""
