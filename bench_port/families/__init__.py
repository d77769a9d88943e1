"""How each model family of a configuration is built in the program under
test, found by the configuration's ``model.family``."""
