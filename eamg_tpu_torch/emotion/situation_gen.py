"""Compositional situation generator (VERDICT r3 task #2).

The hand-written situation banks (distill_data._SITUATIONS*) topped out
around 42 scenarios per label, with schema COUNT the measured lever and
hand-curation the bottleneck (round-3 notes: "schema count never
saturated"). This module composes scenarios from per-label EVENT frames
x per-label CONSEQUENCE clauses x shared label-neutral INTRO clauses x
the shared slot vocabularies — hundreds of distinct schema combinations
and thousands of surface forms per label instead of a static list.

Reference gap attacked: the reference rides a 66M pretrained DistilBERT
whose world knowledge maps situations to emotions for free
(emotion_analysis/modeling.py:15-18); the from-scratch model must be
TAUGHT the situation->emotion mapping, and teaching requires scenario
diversity at a scale hands don't reach.

Contract (same as the hand banks): NO feeling words and no own-label
cue forms — the label rides what happened, never a named emotion
(tests/test_emotion_situation_gen.py lints every template against
every label's keyword bank, own label included).

Split discipline: the LAST ``N_EVAL_EVENTS`` event frames and
``N_EVAL_CONSEQ`` consequence clauses of every label are eval-only.
Training never touches them, so eval sentences compose an unseen event
schema with an unseen consequence clause. The FROZEN EXAM
(emotion/frozen_exam.json) was cut once from that eval split and
committed; a test pins its hash, so the exam number is longitudinally
comparable across corpus versions — the metric-hygiene fix for
eval_situations re-randomizing as banks grow (VERDICT r3 weak #1).

Port of ``eamg_tpu/emotion/situation_gen.py``, a copy; the port keeps its
own byte copy of ``frozen_exam.json`` beside this module.
"""

from __future__ import annotations

import json
import os
import random

from .config import ID2LABEL

# Shared, label-neutral scene-setting clauses. Prepended to a fraction
# of sentences so no label owns any opener. Slots come from
# distill_data._SIT_SLOTS (imported lazily to avoid a cycle).
INTROS: list[str] = [
    "this morning",
    "late last night",
    "over the weekend",
    "halfway through the {event}",
    "just after the {event}",
    "earlier today",
    "at the end of the shift",
    "on the drive home",
]

# Per-label schemas. "events" are complete scenario clauses; the last
# N_EVAL_EVENTS of each list are eval-only. "consequences" are factual
# follow-on clauses (no feeling words) appended after a comma; the last
# N_EVAL_CONSEQ are eval-only.
SCHEMAS: dict[str, dict[str, list[str]]] = {
    "admiration": {
        "events": [
            "{person} tuned the {object} by ear in one pass and it held all night",
            "the surgeon talked the room through every step without raising her voice",
            "{person} memorized the entire route after driving it once",
            "the old mason matched the stone by eye and you cannot find the seam",
            "she fielded every question from the board without a single note card",
            "the translator kept pace with three speakers at once for two hours",
            "he plated forty dinners during the rush and every one came out level",
            # eval-only
            "{person} coached the juniors to the {event} final in a single season",
            "she landed the glider in a crosswind that grounded everyone else",
            "the apprentice rewired the {object} from a sketch and it ran on the first switch",
        ],
        "consequences": [
            "and made it look effortless",
            "and the whole {room} went quiet to watch",
            "i could not look away",
            "people still talk about it at every {event}",
            # eval-only
            "and never once asked for credit",
            "the rest of us just put our tools down",
        ],
    },
    "amusement": {
        "events": [
            "the cat filed a formal objection to the new {object} by sitting in it",
            "{person} rehearsed the toast all week and then introduced the groom by the dog's name",
            "the smart speaker answered the baby monitor and they argued for an hour",
            "the mascot tripped over the banner and took the mayor down with it",
            "{person} texted the group chat a grocery list meant for the plumber",
            "the seagull grabbed the ring box and the whole {event} chased it down the beach",
            "my uncle set the microwave clock by unplugging it and called it fixed for a year",
            # eval-only
            "the ventriloquist had no voice so the dummy canceled the show on his behalf",
            "{person} waved back at someone waving at the person behind them for a full minute",
            "the robot vacuum herded every {object} into the {room} overnight",
        ],
        "consequences": [
            "we had to pull over",
            "nobody could finish a sentence after that",
            "the video is forty seconds of pure wheeze",
            "half the {room} was on the floor",
            # eval-only
            "and it gets better every retelling",
            "i replay it whenever the day drags",
        ],
    },
    "anger": {
        "events": [
            "the garage swapped the part i paid for with a used one and backdated the receipt to hide it",
            "{person} read my private messages out loud at the {event}",
            "the agency kept my deposit and relisted the apartment the same afternoon",
            "they demolished the community garden a week before the vote they promised",
            "the insurer signed off on the claim, then reversed it the day the invoice arrived",
            "the towing company scratched the car, then charged a fee to dispute the scratch",
            "the clinic billed me for an appointment they cancelled themselves",
            # eval-only
            "{person} took the credit for the {object} restoration i did over the whole winter",
            "my manager scheduled me for the holiday i traded three shifts to get off, and waved it away",
            "somebody drained the fuel from the {object} {place} overnight, second time this month",
        ],
        "consequences": [
            "and hr keeps marking the ticket resolved",
            "and now they won't put anything in writing",
            "no apology, not even a call back",
            "and they did it knowing exactly what it meant",
            # eval-only
            "i am still waiting for anyone to take responsibility",
            "and the manager talked to me like i was the problem",
        ],
    },
    "annoyance": {
        "events": [
            "the printer asks for the same driver every single morning",
            "{person} reply-alls the entire building with a one-word message, every time",
            "the parking app needs three updates a week and forgets my plate after each one",
            "the {object} beeps twice an hour and the manual does not mention beeping",
            "the elevator skips the third floor unless you press the button twice, and nobody will fix it",
            "{person} hums the same four bars {time}, never the fifth",
            "the self checkout flags my bag on every single item, and the light takes a person to reset",
            # eval-only
            "the meeting that could have been one line gets booked for an hour, weekly",
            "the neighbor's wind chime has exactly one note and the wind never lets it rest",
            "the form logs me out on the last page, and only the last page",
        ],
        "consequences": [
            "every single day",
            "and everyone acts like that is normal",
            "it is the third time this week",
            "and the fix has been 'coming' {time}",
            # eval-only
            "small thing, but it is never just once",
            "and of course it happened again this morning",
        ],
    },
    "approval": {
        "events": [
            "the council finally adopted the crossing plan the parents drafted",
            "the new landlord put the heating decision to a tenant vote",
            "{person} gave the interns full bylines on the report they wrote",
            "the cafe started letting the night crew take the unsold bread home",
            "the league added a junior division so the small clubs could compete",
            "the update rolled back the change nobody asked for",
            "{person} stepped up first and fixed the {object} before anyone had to ask",
            # eval-only
            "the city repainted the bike lane wider after the riders petitioned",
            "the chef sources the whole menu from the farms two roads over",
            "the school moved the test so it would not clash with the harvest {event}",
        ],
        "consequences": [
            "exactly how it should be handled",
            "more of this, please",
            "that is the standard everyone else should copy",
            "i would have voted for it twice",
            # eval-only
            "credit where it is due",
            "well handled from start to finish",
        ],
    },
    "caring": {
        "events": [
            "{person} drove two towns over with soup when the whole house came down with the flu",
            "she keeps a spare coat in the truck for whoever forgets theirs",
            "the bus driver waits until the old man is through his gate before pulling away",
            "{person} learned to braid hair just so the mornings would go easier for the little one",
            "he texts the group when the ice is bad on the hill so nobody slips",
            "the team pooled their leave so the new father could stay home the first month",
            "{person} walks the neighbor's dog {time} without being asked, and just leaves a note",
            # eval-only
            "she saves the aisle seat for my bad knee on every single trip",
            "the coach benched his star so the kid could heal properly, season or no season",
            "{person} left the porch light on and dinner in the oven for whoever got in late",
        ],
        "consequences": [
            "nobody asked, they just did it",
            "quietly, like always",
            "and checked in again the next morning",
            "without making it a thing",
            # eval-only
            "that is just who they are",
            "and never mentioned it once",
        ],
    },
    "confusion": {
        "events": [
            "the parcel says delivered thursday, the tracking says still in depot, and the courier app shows neither",
            "{person} swears the meeting moved to tuesday but the invite says thursday and the {room} is double booked",
            "the map app says the street exists, and the street very much does not",
            "the {object} arrived with two manuals that contradict each other on page one",
            "half the emails say the {event} is cancelled and half say bring chairs",
            "the label says add water first, the box says never add water first",
            "my key opens the neighbor's door now and mine opens nothing",
            # eval-only
            "the schedule has me in two buildings at the same hour and both managers signed it",
            "the recipe doubles everything except the flour, with no explanation",
            "{person} introduced me to someone i have apparently known for years",
        ],
        "consequences": [
            "i have read it five times and i am no closer",
            "none of it lines up",
            "somebody explain the middle step to me",
            "which one am i supposed to believe",
            # eval-only
            "the more i look the less it adds up",
            "and everyone else just nods along",
        ],
    },
    "curiosity": {
        "events": [
            "there is a door in the basement that was bricked over and painted, and the paint is new",
            "{person} gets the same unmarked package {time} and never says what is in it",
            "the attic floorboard sounds different under the third nail, like there is a space beneath",
            "the library keeps one cabinet locked and the key is not on the ring",
            "every night at nine the light {place} blinks three times, exactly three",
            "the old photo shows our house with a tower that is not there anymore",
            "{person} speaks a language on the phone that nobody can place",
            # eval-only
            "the ledger from 1911 stops mid sentence on the last page",
            "the cat stares at the same blank corner of the {room} every evening",
            "the antique {object} has a compartment that only opens at an angle",
        ],
        "consequences": [
            "i need to know what is in there",
            "i have a list of questions as long as my arm",
            "what is the story there",
            "somebody has to know more about this",
            # eval-only
            "i will not sleep until i figure it out",
            "i keep going back to look at it",
        ],
    },
    "desire": {
        "events": [
            "the listing for the lakeside cabin has been open in my browser {time}",
            "the guitar in the pawn shop window is the exact model from the poster on my wall",
            "they posted the job in lisbon, remote optional, start date flexible",
            "the travel page keeps showing me the night train through the alps",
            "{person} got the studio with the north window and the high ceiling",
            "the menu has the tasting flight i have been reading about all year",
            "the catalog opened straight to the workbench with the built-in vise",
            # eval-only
            "two tickets left for the closing night show",
            "the scholarship covers the whole year abroad, and applications open monday",
            "the neighbor is selling the {object} i have borrowed four times",
        ],
        "consequences": [
            "i have checked the price four times today",
            "i already know exactly where it would go",
            "i caught myself planning the packing list",
            "i walked past twice just to look again",
            # eval-only
            "one day, and that day is hopefully soon",
            "my savings account and i need to have a talk",
        ],
    },
    "disappointment": {
        "events": [
            "the headliner pulled out an hour before doors and the refund is venue credit",
            "after three rounds of interviews they went with an internal hire",
            "we drove all day and the lookout was fogged in solid",
            "the sequel to my favorite series reads like it was written by a committee",
            "{person} promised to be at the {event} and the seat stayed empty again",
            "the renovation came out beige, all of it, every wall we picked colors for",
            "the scale came back and the big fish was two pounds short of the record",
            # eval-only
            "my tomatoes came up all vine and no fruit this year",
            "the championship came down to a coin flip rule nobody knew existed",
            "the kit arrived with every piece except the one that matters",
        ],
        "consequences": [
            "after all that buildup",
            "we had planned the whole month around it",
            "i really thought this was the one",
            "and that was that, i suppose",
            # eval-only
            "maybe next year, again",
            "it was supposed to be the good part",
        ],
    },
    "disapproval": {
        "events": [
            "they scheduled the layoffs call for the friday before the {event}",
            "{person} parks across both spots outside the clinic, daily",
            "the committee gave the award to the sponsor's nephew, again",
            "the restaurant charges a service fee and still lists tips as expected, in bold",
            "the landlord painted over the mold instead of fixing the leak",
            "they cut the school music program and bought a new scoreboard the same week",
            "{person} let the intern take the blame in front of the whole floor",
            # eval-only
            "the brochure photoshopped a beach onto a parking lot",
            "the app sells your location and calls it improving your experience",
            "they shortened the lunch break by ten minutes and announced it as wellness",
        ],
        "consequences": [
            "who signs off on that",
            "that is not how you treat people",
            "and they know better",
            "somebody should have said no in that meeting",
            # eval-only
            "they are supposed to be better than this",
            "it teaches everyone watching the worst possible lesson",
        ],
    },
    "disgust": {
        "events": [
            "the fridge in the {room} has a container labeled 2019 and it moved",
            "something leaked through the ceiling tile onto the buffet table",
            "the rental's drain was clogged with somebody else's hair, a fistful of it",
            "{person} double dipped the serving spoon straight from the jar, mid cold",
            "the gas station sushi was warm and the rice shifted when i looked closer",
            "the gym towel bin had not been emptied since the {event}, you could tell from the door",
            "the landlord's deep clean left grease thick enough to write in on the hood",
            # eval-only
            "the mattress they delivered had a stain shaped like a country",
            "the office coffee pot grows a film if it sits past noon",
            "the {object} from the flea market smelled like the bottom of a pond, because that is where it had been",
        ],
        "consequences": [
            "i had to step outside",
            "i cannot unsee it",
            "i am never eating there again",
            "i scrubbed up to the elbows and it was not enough",
            # eval-only
            "i threw the whole thing away, container included",
            "some things cannot be rinsed off",
        ],
    },
    "embarrassment": {
        "events": [
            "i gave the whole presentation with the camera on when i thought it was off, hair towel and all",
            "i called the teacher 'mom' in front of the entire class, at thirty-four",
            "my card declined at the register with the whole {event} line behind me",
            "i waved at {person} across the street for a solid block, and it was a stranger in the same coat",
            "the microphone was live while i practiced my acceptance speech, and there was no award",
            "i tucked my skirt into my tights and did a full lap of the {room}",
            "i replied to the company-wide email with the message meant for my dentist",
            # eval-only
            "i clapped alone between movements at the recital, twice",
            "my phone played the cartoon theme at full volume during the minute of silence",
            "i introduced myself to {person}, who reminded me we had met four times",
        ],
        "consequences": [
            "the floor declined to open up and swallow me",
            "everyone saw, everyone",
            "i am never living that down",
            "i left through the side door",
            # eval-only
            "i still replay it at two in the morning",
            "and then i had to sit there for another hour",
        ],
    },
    "excitement": {
        "events": [
            "the tour dates dropped and the hometown show is a friday",
            "we got the keys to the new place this afternoon",
            "the launch window opens tonight and the sky is perfectly clear",
            "{person} just texted 'check your email' with five exclamation points",
            "the bracket came out and we drew the home slot for the {event}",
            "the package is out for delivery, four stops away",
            "they announced the sequel, and the whole original cast is back",
            # eval-only
            "the snow forecast doubled overnight and the passes open at dawn",
            "boarding starts in twenty minutes and my seat is the window over the wing",
            "the demo we sent out got us a meeting with the label",
        ],
        "consequences": [
            "i have already packed twice",
            "i cannot sit still",
            "we are counting down the hours",
            "sleep is not happening tonight",
            # eval-only
            "i keep refreshing the tracking page",
            "tell everyone, tell them now",
        ],
    },
    "fear": {
        "events": [
            "the brakes went soft halfway down the grade with the trailer pushing",
            "something big moved between the tents just past the fire line",
            "the elevator dropped half a floor before the catch grabbed",
            "the ice made a long low crack while we were still far from the shore",
            "a stranger tried the back door handle at three in the morning",
            "the pilot came on and told the crew, not the passengers, to sit down",
            "the doctor's office called and said bring someone with you",
            # eval-only
            "the carbon monoxide alarm went off in the night, and the meter confirmed it",
            "headlights matched every turn we made for twenty minutes, even the turns that led nowhere",
            "the dog went stiff at the tree line and backed toward us slowly",
        ],
        "consequences": [
            "my hands would not stay steady",
            "we did not speak until we were out",
            "i counted every second of it",
            "i have never driven that carefully in my life",
            # eval-only
            "we left everything and walked out",
            "i still check the door twice because of it",
        ],
    },
    "gratitude": {
        "events": [
            "a stranger pushed the stalled car off the crossing before the gates came down",
            "{person} covered my shift, no questions, when the school called",
            "the mechanic stayed past close to get the van running before our long drive",
            "the neighbors cleared our walk {time} while the cast was on",
            "the librarian set aside the last copy without my even asking",
            "the couple in front of us quietly paid for our table and left",
            "{person} drove through the storm to bring the charger for the monitor",
            # eval-only
            "my old teacher wrote the reference the same night i asked",
            "the search crew went back out a third time and found the dog",
            "the landlord waived the month when the plant shut down, unasked",
        ],
        "consequences": [
            "i owe them more than a casserole can say",
            "i will not forget it",
            "people like that keep the world running",
            "they were gone before i could say anything",
            # eval-only
            "we would have been stranded without them",
            "how do you even begin to repay that",
        ],
    },
    "grief": {
        "events": [
            "her reading glasses are still on the nightstand and i cannot move them",
            "the phone contact is still there, and i almost called it on his birthday",
            "the workshop still smells like his pipe",
            "mom's handwriting turned up on a recipe card tucked in the flour tin",
            "the vet returned the collar in a small plastic bag",
            "his voicemail greeting is the only recording of his voice we have left",
            "the garden came up this spring exactly the way she planned it last fall",
            # eval-only
            "i set two cups out of habit and had to put one back",
            "she is in every one of the {event} photos, mid sentence",
            "the tailor asked when he is coming to pick up the suit",
        ],
        "consequences": [
            "the house is too quiet now",
            "i keep forgetting, then remembering",
            "a year on, it still catches me at the sink",
            "nobody warns you about the small things",
            # eval-only
            "i am not ready to change a single thing",
            "some mornings i still reach for the phone",
        ],
    },
    "joy": {
        "events": [
            "the whole family made it home for the {event}, every last one",
            "the baby said her first word today and it was my name",
            "we paid off the house this morning, three years early",
            "the adoption went through, and she is officially ours",
            "it snowed on the eve of the {event} for the first time in a decade here",
            "the old crew is all in one kitchen again, pots going, music on",
            "the first tomato of the season, eaten warm, standing in the garden",
            # eval-only
            "the acceptance came and dad rang the dinner bell for the whole street",
            "we danced in the kitchen until the neighbors joined instead of knocking",
            "the whole block came out to the first warm evening, every porch full",
        ],
        "consequences": [
            "days like this are the whole point",
            "if i could bottle one afternoon, it would be this one",
            "everything is exactly where it should be",
            "we stayed up late just to make it last",
            # eval-only
            "the kitchen has not been this loud in years",
            "the photos do not even come close",
        ],
    },
    "love": {
        "events": [
            "he still puts her plate down first, forty years in",
            "she learned his grandmother's language just to hear the old stories firsthand",
            "he keeps the first movie stub in his wallet behind the license",
            "they still hold hands in the grocery line like teenagers",
            "she drives him to dialysis every tuesday and calls it their date",
            "he learned to cook her mother's recipes from memory, taste by taste",
            "the lock screen is still the photo from the day they met",
            # eval-only
            "she saves the window seat and he saves the aisle, every flight, no discussion",
            "he waited out the whole deployment writing one letter a day",
            "they renewed their vows in the same diner booth where it started",
        ],
        "consequences": [
            "that is the whole thing, in one picture",
            "you cannot fake that",
            "that is what the songs are about",
            "forty years and counting",
            # eval-only
            "some things only deepen",
            "the rest is just details",
        ],
    },
    "nervousness": {
        "events": [
            "the results post at nine and it is eight fifty-one",
            "my name is third on the audition list and they are running fast",
            "the interview panel is four people and one of them wrote the textbook",
            "the driving examiner got in, clipboard first, and said nothing",
            "they moved my presentation up to directly after lunch, today",
            "first solo flight is tomorrow and the wind forecast keeps changing",
            "the recruiter said 'we will call you tonight either way'",
            # eval-only
            "i hit send on the manuscript to the one editor who matters",
            "the scoreboard says two minutes and we are up by one",
            "the {event} hosts announce the shortlist at the top of the hour",
        ],
        "consequences": [
            "i have rewritten my opening line nine times",
            "my leg will not stop bouncing",
            "i keep checking my phone every forty seconds",
            "i could not finish breakfast",
            # eval-only
            "everything is fine, probably, maybe",
            "i have read the same page four times",
        ],
    },
    "optimism": {
        "events": [
            "the first green shoots are up through the late frost",
            "the new manager actually asked what we need, and wrote it down",
            "bookings for spring are already double last year's",
            "the physio says the knee is ahead of schedule",
            "they broke ground on the clinic the town waited a decade for",
            "the early notes from the test readers came back strong",
            "the rain finally reached the reservoir catchment this week",
            # eval-only
            "the night class filled up with people from the old plant",
            "her first sentences are coming faster every week since the therapy change",
            "the union and the owners are back at the table, and they ordered lunch in",
        ],
        "consequences": [
            "this is going to be a good year",
            "things are finally pointing the same direction",
            "the corner is there and we are turning it",
            "give it one more season and watch",
            # eval-only
            "the hard part is behind us now",
            "it is all forward from here",
        ],
    },
    "pride": {
        "events": [
            "my daughter's name was on the published paper, second author, age nineteen",
            "the shelf i built holds the encyclopedias, all of them, level",
            "our shop's jam took first at the county {event}, beating the big brands",
            "the kid who could not read in september read the morning announcements today",
            "i ran the whole distance without walking a single step, first time",
            "the team i trained ran the launch without calling me once",
            "three generations of us have kept the farm going and the fourth just signed on",
            # eval-only
            "my bread finally came out of the oven looking like the book's photo",
            "the app i wrote at the kitchen table passed a thousand users today",
            "dad pointed at the bridge and told everyone on the boat that his crew built it",
        ],
        "consequences": [
            "i may have mentioned it more than once",
            "the photo is going on the wall",
            "we earned every inch of that",
            "nobody can take that away",
            # eval-only
            "i stood a little taller all day",
            "made every early morning worth it",
        ],
    },
    "realization": {
        "events": [
            "the rattle was never the engine, it was a loose coin in the cup holder the whole time",
            "the recipe said one stick of butter and i have been using two for years",
            "the plant was never leaning at the window, it follows the hallway light",
            "the 'typo' in grandma's ring engraving is her maiden name",
            "the meeting that runs long every week is scheduled over lunch on purpose",
            "i have been calling {person} by their brother's name for a year and everyone just let it happen",
            "the map was upside down the entire hike",
            # eval-only
            "the discount store and the fancy store sell the same {object}, same factory sticker",
            "the noise upstairs was the dryer's worn belt all along, not the neighbors",
            "my lucky route to work is just the one with synchronized lights",
        ],
        "consequences": [
            "now the whole year reads differently",
            "how did i not see it sooner",
            "suddenly every odd detail fits",
            "the signs were there the entire time",
            # eval-only
            "i had to sit down and re-think the whole year",
            "well, that clears up the last five years",
        ],
    },
    "relief": {
        "events": [
            "the lump was a cyst, benign, and the surgeon said it twice so we would hear it",
            "the missing hiker walked into base camp on his own at dawn",
            "the passport turned up in the lining of the bag at the gate, with minutes to spare",
            "the storm turned out to sea overnight and the roof held",
            "the audit closed with a single footnote and no findings",
            "the dog trotted out from under the porch when the treats rattled, unhurt",
            "the recall notice came and ours was already fixed",
            # eval-only
            "the final payment cleared and the loan page finally reads zero",
            "she called from the landline — battery dead, ferry late, nothing more",
            "the x-ray showed a sprain, not a break, season still on",
        ],
        "consequences": [
            "my shoulders came down from around my ears",
            "we slept properly for the first time in a week",
            "it missed us by inches, but it missed us",
            "i can stop refreshing the news now",
            # eval-only
            "it is over, actually over",
            "dinner tasted like food again",
        ],
    },
    "remorse": {
        "events": [
            "i forwarded the email before reading to the bottom, where the confidential part was",
            "i missed her last recital for a meeting that got cancelled anyway",
            "i repeated the secret at the {event} and watched it travel the room",
            "i picked the sharpest words at dinner and the table went quiet",
            "i sold his {object} in the garage sale, the one thing he asked me to keep",
            "i went along when the group turned on the new hire, and said nothing",
            "i promised the kid the fishing trip three summers running and never once delivered",
            # eval-only
            "i skipped the visit i kept saying i would make, and then the chance was gone",
            "i borrowed from the register meaning to put it back friday, and they counted thursday",
            "i told them the shortcut was safe without checking the bridge myself",
        ],
        "consequences": [
            "i would give anything to take it back",
            "the apology came years too late",
            "i knew better even while i was doing it",
            "it was my call, and i have to live with it",
            # eval-only
            "no one blames me as much as i do",
            "i still owe her that conversation",
        ],
    },
    "sadness": {
        "events": [
            "the moving truck pulled away with my best friend's whole life in it",
            "the playground where everyone met got fenced off and paved this week",
            "the last of the summer crew left on the early train",
            "the shop on the corner is empty now, paper over the windows, after sixty years",
            "the old dog can't make the stairs anymore, so we carried him up",
            "nobody came to the open mic and he played the whole set anyway, to the chairs",
            "the house finally sold, and the new owners' first act was taking down the tree house",
            # eval-only
            "the rain set in the day the fair closed for good",
            "her side of the closet is boxes now, labeled for the charity shop",
            "the reunion was four of us this year, down from forty",
        ],
        "consequences": [
            "the street feels emptier already",
            "i sat with it for a long while",
            "some doors close quietly",
            "it is the end of something, and we all knew it",
            # eval-only
            "i did not have words for the drive home",
            "the season just went gray",
        ],
    },
    "surprise": {
        "events": [
            "the 'quick team sync' turned out to be a room full of balloons and my name on a cake",
            "my quiet coworker took the mic at the {event} and has apparently toured with a band",
            "the scratch ticket from the glovebox, two years old, hit four figures",
            "the 'intern' we onboarded all week owns the company",
            "i opened the {object} to fix it and found a note addressed to me by name, dated 1998",
            "the delivery was a piano, a full piano, addressed correctly",
            "my parents sold the house and bought a boat, announced via postcard",
            # eval-only
            "the understudy stepped out and it was the original lead, back unannounced for one night",
            "the door prize at the {event} was a car, an actual car",
            "{person} walked in mid-dinner, straight off a flight nobody knew about",
        ],
        "consequences": [
            "nobody saw that coming",
            "i dropped my fork, truly",
            "the room went silent, then very loud",
            "i had to read it twice",
            # eval-only
            "we are still piecing together how they kept it quiet",
            "you could have knocked me over with a feather",
        ],
    },
    "neutral": {
        "events": [
            "the {room} gets repainted in the first week of october",
            "the ferry timetable switches to winter hours after the {event}",
            "the {object} takes two batteries, the square kind",
            "street sweeping alternates sides on tuesdays and fridays",
            "the library's return slot stays open when the desk is closed",
            "the 41 bus terminates two stops early on match days",
            "the invoice template lives in the shared folder under admin",
            # eval-only
            "the thermostat is set from the panel in the {room}, not the app",
            "recycling goes out the night before, bins facing the street",
            "the spare key to the {room} hangs in the cabinet by the meter",
        ],
        "consequences": [
            "per the notice on the board",
            "same as last year",
            "the schedule is on the website",
            "it has been that way since the remodel",
            # eval-only
            "check the posted hours to confirm",
            "the manual covers it in section three",
        ],
    },
}

N_EVAL_EVENTS = 3
N_EVAL_CONSEQ = 2

# probability knobs for composition (train-time surface diversity)
P_CONSEQUENCE = 0.6
P_INTRO = 0.35

_EXAM_PATH = os.path.join(os.path.dirname(__file__), "frozen_exam.json")


def _slots() -> dict[str, list[str]]:
    from .distill_data import _SIT_SLOTS

    return _SIT_SLOTS


def _fill(tmpl: str, rng: random.Random) -> str:
    return tmpl.format(**{k: rng.choice(v) for k, v in _slots().items()})


def split_schemas(label: str, split: str) -> tuple[list[str], list[str]]:
    """(events, consequences) for ``split`` in {"train", "eval"}. The
    eval tail never trains, so eval/exam sentences compose an unseen
    event frame with an unseen consequence clause."""
    ev = SCHEMAS[label]["events"]
    cq = SCHEMAS[label]["consequences"]
    if split == "train":
        return ev[:-N_EVAL_EVENTS], cq[:-N_EVAL_CONSEQ]
    if split == "eval":
        return ev[-N_EVAL_EVENTS:], cq[-N_EVAL_CONSEQ:]
    raise ValueError(split)


def generate(label: str, rng: random.Random, n: int,
             split: str = "train") -> list[str]:
    """``n`` composed scenario sentences for ``label``. Composition:
    [intro, ]event[, consequence] with shared slot fills; intros and
    slots are label-neutral, the event+consequence carry the label."""
    events, conseqs = split_schemas(label, split)
    out = []
    for _ in range(n):
        s = _fill(rng.choice(events), rng)
        if conseqs and rng.random() < P_CONSEQUENCE:
            s = f"{s}, {_fill(rng.choice(conseqs), rng)}"
        if rng.random() < P_INTRO:
            s = f"{_fill(rng.choice(INTROS), rng)}, {s}"
        out.append(s)
    return out


def schema_count(label: str, split: str = "train") -> int:
    """Distinct (intro? x event x consequence?) schema combinations."""
    ev, cq = split_schemas(label, split)
    return len(ev) * (1 + len(cq)) * (1 + len(INTROS))


def build_frozen_exam(per_label: int = 6,
                      seed: int = 20260820) -> list[tuple[str, str]]:
    """Cut the frozen exam from the eval split: ``per_label`` distinct
    sentences per label. Run ONCE (tools side); the committed JSON is
    the exam — regenerating after grammar edits would break
    longitudinal comparability, which is the exam's whole point."""
    rng = random.Random(seed)
    out = []
    for label in sorted(SCHEMAS):
        seen: set[str] = set()
        while len(seen) < per_label:
            for s in generate(label, rng, per_label, split="eval"):
                if s not in seen:
                    seen.add(s)
                    out.append((s, label))
                    if len(seen) == per_label:
                        break
    return out


def frozen_exam() -> list[tuple[str, str]]:
    """The committed exam: [(text, label)]. 6 x 28 = 168 sentences cut
    once from the eval schema split (build_frozen_exam) and frozen;
    tests pin the file hash."""
    with open(_EXAM_PATH, encoding="utf-8") as f:
        return [(r["text"], r["label"]) for r in json.load(f)]


def write_frozen_exam(path: str = _EXAM_PATH, per_label: int = 6,
                      seed: int = 20260820) -> None:
    rows = [{"text": t, "label": l}
            for t, l in build_frozen_exam(per_label, seed)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, indent=1)


def generator_crosstalk() -> list[tuple[str, str, str, str]]:
    """Same lint as distill_data.situation_crosstalk, over the
    generator's event + consequence templates: templates containing ANY
    label's keyword-bank form — own label included (a cue word in a
    situation template would let the cue, not the schema, carry the
    label; the ADVICE r3 'approval/right' finding generalized)."""
    import re

    from .distill_data import label_banks

    banks = label_banks()
    word_forms = {label: {f for f in forms if " " not in f and f.isalpha()}
                  for label, forms in banks.items()}
    phrase_forms = {label: [f for f in forms if " " in f]
                    for label, forms in banks.items()}
    hits = []
    for label, spec in SCHEMAS.items():
        for tmpl in spec["events"] + spec["consequences"]:
            text = re.sub(r"\{[a-z]+\}", " ", tmpl)
            words = set(re.findall(r"[a-z']+", text))
            for other, forms in word_forms.items():
                for w in words & forms:
                    hits.append((label, tmpl, other, w))
            for other, phrases in phrase_forms.items():
                for p in phrases:
                    if re.search(r"\b" + re.escape(p) + r"\b", text):
                        hits.append((label, tmpl, other, p))
    return hits


def _sanity() -> None:
    labels = set(ID2LABEL.values())
    assert set(SCHEMAS) == labels, sorted(labels ^ set(SCHEMAS))
    for label, spec in SCHEMAS.items():
        assert len(spec["events"]) == 10, (label, len(spec["events"]))
        assert len(spec["consequences"]) == 6, label


_sanity()
