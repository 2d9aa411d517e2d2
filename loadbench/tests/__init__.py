"""CPU tests of the benchmark; the tests marked ``cuda`` run on a card only."""
