"""Training of the port: the train step and the LM training driver."""
