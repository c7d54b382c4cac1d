"""The plain reference that decides ``correct``: numpy only, nothing of the
program."""
