"""The port's model server: stdlib WSGI and JSON."""
