"""Cost analysis of the port's programs without a device (`trace`)."""
