"""nn.Modules of the port, named after the torch reference."""
