"""models subpackage."""
