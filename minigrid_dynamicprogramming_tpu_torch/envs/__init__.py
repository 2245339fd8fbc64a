"""Layout generators, one module per env family."""
