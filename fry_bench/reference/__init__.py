"""The plain reference: one module a stage's semantics, named by a
traffic stage's ``reference``.  Each ``expect(data, params, state)``
works out the stage's artifacts from the generated records alone; it
imports nothing of the program."""
