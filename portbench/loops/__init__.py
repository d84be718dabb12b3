"""One module a loop (``<loop>.py``), named by a traffic file's ``loop``:
``run(host, window, root)`` drives the port through set-up and the window
and returns what its judge needs; ``judge(kept, control)`` compares that
with the plain reference after the window and returns ``(numbers,
controls)``, the control's numbers only when ``control`` is set."""
