from chaq_sdfgen.cli import main
import sys

sys.exit(main())
