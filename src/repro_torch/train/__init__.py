"""Training of the port: step functions and the trainer loop."""
