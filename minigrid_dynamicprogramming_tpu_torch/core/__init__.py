"""Integer codes, state records and the environment record."""
