"""The plain reference that decides whether a benchmark run is correct.
It imports nothing of the program under test."""
