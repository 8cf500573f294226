"""Each cell kind's system under test, built from the port's entry points."""
