"""explain subpackage."""
