"""The systems under test, one module a kind of configuration, named in its file."""
