"""The cells' data generators (one module a generator, named by a
configuration's ``generator``) and the benchmark's own RAD writer."""
