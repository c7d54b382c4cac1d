"""The benchmark's own generators: the federation, the query pools and the
request stream.  Frozen here, apart from the program, so that a change to
the program cannot move the yardstick."""
