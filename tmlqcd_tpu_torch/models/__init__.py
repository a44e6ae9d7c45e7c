"""Standard action suites."""
