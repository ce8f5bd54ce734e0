"""Device resolution and synthetic test data."""
