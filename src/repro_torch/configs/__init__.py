"""Model and training configurations of the port: the zoo's ten archs and
their variants, and the shape cells."""
