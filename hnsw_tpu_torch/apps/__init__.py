"""End-user applications: the interactive search shell."""
