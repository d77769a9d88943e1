"""How each entry of the program is driven, found by a traffic file's
``entry``: one module a entry, each with a ``Driver`` over :mod:`.common`."""
