"""Operation counts of the configurations, from their shapes."""
