"""Device and dtype conventions of the port."""
