"""Launch topology: the production mesh's shape and the resolution of
abstract partition specs against it (what the fleet extraction needs)."""
