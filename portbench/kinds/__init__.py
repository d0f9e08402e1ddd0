"""The general load generators; a traffic file names its ``kind``, which is
the module here that reads it."""
